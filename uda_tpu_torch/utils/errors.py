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
    "TransportError",
    "MergeError",
    "StorageError",
    "FallbackSignal",
]


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


class TransportError(UdaError):
    """Fetch-plane failure (reference RDMA WC errors and connect failures,
    src/DataNet/RDMAClient.cc:215-356)."""


class MergeError(UdaError):
    """Merge-engine invariant violation (reference merge-thread failures,
    src/Merger/MergeManager.cc)."""


class StorageError(UdaError):
    """Segment IO failure (reference AIOHandler/DataEngine read errors,
    src/MOFServer/IndexInfo.cc:304-376)."""


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
