"""The one traffic generator: reads a mix's parameters
(`perfbench/traffic/<name>.json`) and the cell's (`perfbench/cells/<name>
.json`: its rate) and draws the requests of a run from the seed.

Kinds:
  "open":     an open loop of independent users over the span of
              `warmup_s` before the window and `seconds` in it. The
              count is the cell's `rate_rps` times the span, the same for
              every seed; the arrival times are drawn from the seed by the
              mix's arrival law, conditioned on that count: n + 1 i.i.d.
              gaps scaled to fill the span. With {"dist": "exponential"}
              that is a Poisson process given its count (the arrivals are
              the order statistics of n uniform draws), bursts and lulls
              as Poisson has them; {"dist": "gamma", "cv": c} gives gaps of
              that coefficient of variation (c > 1: burstier, as BurstGPT
              measures). The lengths are the quantiles (i + 1/2) / n of
              the mix's distributions, one set for every seed, in an order
              the seed draws.
  "sessions": `sessions` requests, all due at time 0 (their prefills are
              set-up), each generating until its cache is full.
Length distributions: {"dist": "lognormal", "median", "sigma", "min",
"max"} or {"dist": "uniform", "min", "max"}.
"""

from __future__ import annotations

import dataclasses
import statistics
from typing import Dict, List

import numpy as np

from perfbench.harness.weights import substream


@dataclasses.dataclass
class Planned:
    rid: int
    arrival: float            # seconds after the start of the arrivals
    prompt_len: int
    max_new_tokens: int
    tokens: np.ndarray        # the prompt's token ids


def quantiles(spec: Dict, n: int) -> np.ndarray:
    """n lengths at the quantiles (i + 1/2) / n of `spec`."""
    u = (np.arange(n) + 0.5) / n
    lo, hi = int(spec["min"]), int(spec["max"])
    if spec["dist"] == "lognormal":
        z = np.array([statistics.NormalDist().inv_cdf(x) for x in u])
        v = spec["median"] * np.exp(spec["sigma"] * z)
    elif spec["dist"] == "uniform":
        v = lo + (hi - lo) * u
    else:
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    return np.clip(np.rint(v), lo, hi).astype(np.int64)


def gaps(law: Dict, n: int, rng: np.random.Generator) -> np.ndarray:
    """n i.i.d. gaps of mean 1 under the arrival law `law`."""
    if law["dist"] == "exponential":
        return rng.exponential(1.0, n)
    if law["dist"] == "gamma":
        shape = 1.0 / float(law["cv"]) ** 2
        return rng.gamma(shape, 1.0 / shape, n)
    raise ValueError(f"unknown arrival law {law['dist']!r}")


def generate(mix: Dict, cell: Dict, seed: int, seconds: float, vocab: int,
             s_max: int) -> List[Planned]:
    rng = np.random.default_rng(substream(seed, "traffic"))
    kind = mix["kind"]
    if kind == "open":
        span = float(mix["warmup_s"]) + seconds
        n = int(round(float(cell["rate_rps"]) * span))
        g = gaps(mix["arrivals"], n + 1, rng)
        arrivals = span * np.cumsum(g)[:n] / g.sum()
        prompts = rng.permutation(quantiles(mix["prompt_len"], n))
        outputs = rng.permutation(quantiles(mix["output_len"], n))
    elif kind == "sessions":
        n = int(mix["sessions"])
        arrivals = np.zeros(n)
        prompts = rng.permutation(quantiles(mix["prompt_len"], n))
        outputs = s_max - 2 - prompts
    else:
        raise ValueError(f"unknown traffic kind {kind!r}")
    # the longest pairing any seed could draw
    longest = int(prompts.max() + outputs.max()) if kind == "open" \
        else int((prompts + outputs).max())
    if longest > s_max - 2:
        raise ValueError(f"{mix['name']}: a request of {longest} positions "
                         f"does not fit the engine's s_max {s_max}")
    return [Planned(i, float(arrivals[i]), int(prompts[i]), int(outputs[i]),
                    rng.integers(0, vocab, size=int(prompts[i]),
                                 dtype=np.int32))
            for i in range(n)]
