"""Typed error hierarchy + fallback signalling.

The port's copy of ``uda_tpu/utils/errors.py``, with the classes the
port's modules raise. Equivalent of the reference's ``UdaException``
(backtrace-carrying C++ exception rethrown into Java, reference
src/CommUtils/IOUtility.cc:561-569) and the fallback-to-vanilla machinery
(any native failure flips the Java side back to Hadoop's stock shuffle,
reference src/UdaBridge.cc:506-530).

``FallbackSignal`` plays the role of ``failureInUda``: ``MergeManager.run``
turns any ``UdaError`` raised inside the engine into it, and the caller
decides whether to fall back to its vanilla path.
"""

from __future__ import annotations

import traceback

__all__ = [
    "UdaError",
    "ConfigError",
    "ProtocolError",
    "TransportError",
    "MergeError",
    "StorageError",
    "StoreError",
    "CompressionError",
    "TenantError",
    "FallbackSignal",
    "attribute_supplier",
]


def attribute_supplier(exc: BaseException, supplier: str) -> None:
    """Stamp the structured failing-supplier attribution onto ``exc``
    (see :attr:`UdaError.supplier`): first writer wins, and foreign
    exception types without attribute slots are tolerated."""
    if getattr(exc, "supplier", None) is None:
        try:
            exc.supplier = supplier
        except AttributeError:
            pass  # foreign exception type without attribute slots


class UdaError(Exception):
    """Base error. Captures a formatted backtrace at construction, like the
    reference's UdaException embeds a C++ backtrace in its message
    (IOUtility.cc:561-569).

    ``supplier`` is the STRUCTURED failing-source attribution (None =
    unattributed): the penalty box keys on it, when a transport sets it,
    without parsing reason strings."""

    supplier = None  # failing supplier host/label, when attributable

    def __init__(self, message: str):
        self.backtrace = "".join(traceback.format_stack()[:-1])
        super().__init__(message)


class ConfigError(UdaError):
    """Bad or missing configuration, or a configured mode this build
    cannot honour (reference parse_options failures,
    src/CommUtils/C2JNexus.cc:43-137)."""


class ProtocolError(UdaError):
    """Malformed control-plane command (reference parse_hadoop_cmd,
    src/CommUtils/C2JNexus.cc:141-207)."""


class TransportError(UdaError):
    """Fetch-plane failure (reference RDMA WC errors and connect failures,
    src/DataNet/RDMAClient.cc:215-356)."""


class MergeError(UdaError):
    """Merge-engine invariant violation (reference merge-thread failures,
    src/Merger/MergeManager.cc)."""


class StorageError(UdaError):
    """Segment IO failure (reference AIOHandler/DataEngine read errors,
    src/MOFServer/IndexInfo.cc:304-376)."""


class StoreError(StorageError):
    """Disaggregated MOF-store failure. ``cause`` is the structured
    failure class and ``backend`` the tier that produced it; both default
    empty, so the failpoint runtime's one-message construction stays
    legal."""

    def __init__(self, message: str, cause: str = "", backend: str = ""):
        super().__init__(message)
        self.cause = cause
        self.backend = backend


class CompressionError(UdaError):
    """Codec failure (reference DecompressorWrapper paths,
    src/Merger/DecompressorWrapper.cc)."""


class TenantError(UdaError):
    """Multi-tenant service-plane refusal: unknown or retired job, stale
    epoch or failed authentication. Terminal on the reduce side."""


class FallbackSignal(Exception):
    """Raised to the embedding application to request fallback-to-vanilla.

    Wraps the originating ``UdaError`` as ``cause`` and carries the cause's
    captured backtrace so the failure point survives the trip across the
    fallback boundary. Raise it ``from cause`` so ``__cause__`` chains
    too. Matches the contract of ``UdaBridge_exceptionInNativeThread`` ->
    Java ``failureInUda`` (reference src/UdaBridge.cc:506-530)."""

    def __init__(self, cause: UdaError):
        self.cause = cause
        self.backtrace = getattr(cause, "backtrace", "")
        super().__init__(f"uda_tpu_torch failure, fallback requested: "
                         f"[{type(cause).__name__}] {cause}")
