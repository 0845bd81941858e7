"""Reduce-side merge of the port (the Merger/ layer): staging arena,
streaming segments, the recovery ledger and the merge manager."""

from uda_tpu_torch.merger.arena import BufferArena, BufferSlot
from uda_tpu_torch.merger.merge_manager import MergeManager, PenaltyBox
from uda_tpu_torch.merger.recovery import RecoveryLedger
from uda_tpu_torch.merger.segment import (HostRoutingClient, InputClient,
                                         LocalFetchClient, Segment)

__all__ = ["BufferArena", "BufferSlot", "MergeManager", "PenaltyBox",
           "RecoveryLedger", "HostRoutingClient", "InputClient",
           "LocalFetchClient", "Segment"]
