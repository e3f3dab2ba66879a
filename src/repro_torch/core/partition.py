"""SM partitions: the GreenContext split a co-located round runs on.

The reference fuses a round's decode step and its k units into one XLA
program and calls that "the TPU analogue of GreenContext SM partitioning"
(`repro/core/colocation.py`). On the card the port makes the split itself:
two green contexts over disjoint sets of SMs, one for decode and one for
the units, each with a stream of its own (`csrc/sm_partition.cu`). A round
forks onto both streams and joins (`core/colocation.py`). torch's own
`torch.cuda.green_contexts.GreenContext.create(num_sms=...)` makes each
context from the whole device, so two of them share SMs; the port's are
made from one split of the device's SM resource, a group and its
remainder, and are disjoint by construction.

The split's size (`split_sizes`) rests on the cost model's
`bw_sat_quantum`, the share of the card at which decode saturates HBM
(the paper's Fig. 9): decode gets that share, rounded up to the driver's
SM granularity, and the units the rest.

`smids` launches the probe kernel, which writes the SM id of each CTA:
`chip_smoke.py` and the card-only tests hold the ids a graph replayed on a
partition's stream writes against that partition's set.

Asking for a split off the card raises, and so does a driver without the
green-context API: nothing falls back to sequential rounds.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import List, Optional, Tuple

import torch

from repro_torch.core.costmodel import H100_CONSTANTS
from repro_torch.kernels import build


def split_sizes(sms: int, granule: int, quantum: float) -> Tuple[int, int]:
    """(decode SMs, unit SMs) of a device of `sms` SMs that the driver
    splits in multiples of `granule`: decode gets ceil(quantum x sms)
    rounded up to the granularity, the units the rest; each side gets at
    least one granule."""
    if granule < 1 or sms < 2 * granule:
        raise ValueError(f"{sms} SMs in granules of {granule} do not make "
                         "two partitions")
    if not 0.0 < quantum <= 1.0:
        raise ValueError(f"quantum {quantum} is not a share of the card")
    decode = math.ceil(math.ceil(round(quantum * sms, 9)) / granule) \
        * granule
    decode = min(max(decode, granule), (sms - granule) // granule * granule)
    return decode, sms - decode


def resolve(split: Optional[bool], device) -> bool:
    """Whether co-located rounds run on an SM split: by default on a CUDA
    device and never on the CPU. Asking for a split off the card raises."""
    dev = torch.device(device)
    if split is None:
        return dev.type == "cuda"
    if split and dev.type != "cuda":
        raise ValueError(f"an SM split needs a CUDA device, not {dev}; pass "
                         "split=False (or leave it unset) for sequential "
                         "rounds")
    return bool(split)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("sm_partition")
    lib.repro_sm_count.argtypes = [ctypes.c_int,
                                   ctypes.POINTER(ctypes.c_int),
                                   ctypes.POINTER(ctypes.c_int)]
    lib.repro_sm_split.argtypes = [ctypes.c_int] * 2 + [
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_void_p)]
    lib.repro_sm_release.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.repro_smid_probe.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                     ctypes.c_longlong, ctypes.c_void_p]
    for fn in (lib.repro_sm_driver_error_string,
               lib.repro_smid_probe_error_string):
        fn.argtypes = [ctypes.c_int]
        fn.restype = ctypes.c_char_p
    return lib


def _driver_check(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} failed: "
                           + _lib().repro_sm_driver_error_string(err).decode())


def _index(device) -> int:
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"an SM split needs a CUDA device, not {dev}")
    return torch.cuda.current_device() if dev.index is None else dev.index


@functools.cache
def device_sms(index: int) -> Tuple[int, int]:
    """(SMs of device `index`, the driver's split granularity)."""
    sms, granule = ctypes.c_int(), ctypes.c_int()
    _driver_check(_lib().repro_sm_count(index, ctypes.byref(sms),
                                        ctypes.byref(granule)),
                  "reading the device's SM resource")
    return sms.value, granule.value


@dataclasses.dataclass(frozen=True)
class Part:
    """One partition: its SM count, green context and stream."""
    sms: int
    stream: torch.cuda.Stream
    ctx: int


class Split:
    """Two disjoint partitions of one device: `decode` (at least
    `decode_sms` SMs, as the driver rounds them) and `units` (the rest).
    `close` destroys both; a split left open lives as long as the
    process."""

    def __init__(self, device, decode_sms: int):
        index = _index(device)
        sms = (ctypes.c_int * 2)()
        ctxs, streams = (ctypes.c_void_p * 2)(), (ctypes.c_void_p * 2)()
        _driver_check(_lib().repro_sm_split(index, decode_sms, sms, ctxs,
                                            streams),
                      f"splitting off {decode_sms} SMs")
        self.device = torch.device("cuda", index)
        self.decode, self.units = (
            Part(sms[i], torch.cuda.ExternalStream(streams[i],
                                                   device=self.device),
                 ctxs[i]) for i in range(2))
        self._open = True

    def close(self) -> None:
        if self._open:
            for part in (self.decode, self.units):
                part.stream.synchronize()
                _driver_check(_lib().repro_sm_release(
                    part.ctx, part.stream.cuda_stream), "releasing a partition")
            self._open = False


@functools.cache
def default_split(index: int) -> Split:
    """The co-located rounds' split of device `index`, made once: decode on
    `bw_sat_quantum` of it (`split_sizes`), the units on the rest."""
    sms, granule = device_sms(index)
    decode, _ = split_sizes(sms, granule, H100_CONSTANTS.bw_sat_quantum)
    return Split(torch.device("cuda", index), decode)


def split_for(device) -> Split:
    return default_split(_index(device))


# the probe: long enough (~30 us at the H100's clock) for a launch to
# spread over every SM it may use
PROBE_SPIN_CYCLES = 60_000


def smid_probe(out: torch.Tensor) -> None:
    """Launch the probe on the current stream: one CTA per element of
    `out` (int32, on the card), each writing its SM id there."""
    if out.dtype != torch.int32 or out.device.type != "cuda" or \
            not out.is_contiguous():
        raise ValueError("the probe writes a contiguous int32 CUDA tensor")
    lib = _lib()
    with torch.cuda.device(out.device):
        err = lib.repro_smid_probe(out.data_ptr(), out.numel(),
                                   PROBE_SPIN_CYCLES,
                                   torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError("the SM-id probe failed to launch: "
                           + lib.repro_smid_probe_error_string(err).decode())


def smids(stream: torch.cuda.Stream, ctas: int) -> List[int]:
    """The SM ids a probe launch of `ctas` CTAs on `stream` ran on."""
    out = torch.full((ctas,), -1, dtype=torch.int32, device=stream.device)
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        smid_probe(out)
    torch.cuda.current_stream().wait_stream(stream)
    return sorted(set(out.tolist()))
