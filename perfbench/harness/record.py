"""What a run hands its metric readers (`perfbench/metrics/<name>.py`,
each `read(rec) -> float or None`)."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from perfbench.harness.engine import Admission, Round
from perfbench.harness.trace import TraceSummary
from perfbench.reference.model import Arch


@dataclasses.dataclass
class Record:
    arch: Arch
    setup_s: float             # process start to the window's opening
    window_s: float            # the window's length, host clock
    rounds: List[Round]        # the window's decode rounds
    admissions: List[Admission]  # the window's admissions
    tokens_out: int            # output tokens emitted in the window
    units: int                 # finetune units run in the window
    units_per_iter: int        # 0: no finetune job
    tokens_per_iter: int
    unit_kinds: Dict[int, str]  # unit index -> kind
    micro_batch: int
    seq_len: int
    qos_s: Optional[float]     # the scheduler's target (None: no job)
    trace: Optional[TraceSummary] = None
