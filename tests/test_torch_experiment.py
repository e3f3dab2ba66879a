"""The port's `ExperimentSpec` (`core/experiment.py`) and its launcher
(`launch/cluster_sim.py`) against the reference's.

* Each of the seven saved specs in `examples/specs/`: loaded by the port,
  `to_json` is byte-equal to the reference's, `validate` passes, and `run`
  on the reference's instance (TPU v5e at the spec's tp, its cost
  constants; `test_torch_costmodel._tpu_instance`) on the spec's trace cut
  to 15 s gives a `ClusterResult` equal to the reference's field by field,
  with the spec's mechanism firing in it (scale actions, the chunk-budget
  trajectory, kills and checkpoint commits, adapter loads, prefix hits,
  gossip digests). `churn_spike`'s kills warn no instance and migrate no
  KV in the reference's run either, even at its full 60 s;
  `tests/test_torch_cluster.py` holds a churn case where they do.
* The schema: a v1 document upgrades to the same spec; the `SpecError`
  texts equal the reference's for the contradictions of
  `tests/test_api.py::test_spec_validation_catches_contradictions`, for
  unknown fields, v2 blocks in a v1 document and unsupported versions.
* `launch/cluster_sim.main(argv)` in process: `--dump-spec` writes the
  same JSON as `examples/cluster_sim.py` for the same flags, both reject
  the same contradictory flags with the same text, and `--spec` runs a
  saved spec on H100 instances, printing the reference's header lines.

The file takes ~40 s alone on an idle machine.
"""

import contextlib
import dataclasses
import glob
import importlib.util
import io
import os
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro.core import experiment as JE  # noqa: E402
from repro.core.cluster import ClusterConfig as JClusterConfig  # noqa: E402
from repro.core.prefill_pool import \
    PrefillPoolConfig as JPoolConfig  # noqa: E402
from repro.core.router import RouterConfig as JRouterConfig  # noqa: E402
from repro.core.simulator import ChunkedPrefillConfig as JChunked  # noqa
from repro.core.simulator import SimConfig as JSimConfig  # noqa: E402
from repro.serving.trace import TraceConfig as JTraceConfig  # noqa: E402
from repro_torch.core import experiment as TE  # noqa: E402
from repro_torch.core.cluster import \
    ClusterConfig as TClusterConfig  # noqa: E402
from repro_torch.core.prefill_pool import \
    PrefillPoolConfig as TPoolConfig  # noqa: E402
from repro_torch.core.router import RouterConfig as TRouterConfig  # noqa
from repro_torch.core.simulator import \
    ChunkedPrefillConfig as TChunked  # noqa: E402
from repro_torch.core.simulator import SimConfig as TSimConfig  # noqa
from repro_torch.launch import cluster_sim as TLAUNCH  # noqa: E402
from repro_torch.serving.trace import \
    TraceConfig as TTraceConfig  # noqa: E402

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_costmodel import _tpu_instance  # noqa: E402
from test_torch_simulator import _state  # noqa: E402

ROOT = Path(__file__).parents[1]
SPECS = sorted(glob.glob(str(ROOT / "examples" / "specs" / "*.json")))
SHORT_S = 15.0


def _acts(res):
    return [d for d in res.decisions if d.action != "none"]


FIRED = {
    "chunked_fused_quantum": lambda r: len(r.chunk_budget_timeline) > 0,
    "churn_spike": lambda r: r.failures > 0 and r.checkpoint_commits > 0,
    "hetero_fleet": lambda r: len(_acts(r)) > 0,
    "multi_tenant_adapters": lambda r: r.adapter_loads > 0
    and len(r.stats.tenants) == 4,
    "session_heavy_cache_aware": lambda r: r.prefix_hits > 0,
    "shared_prefix_gossip": lambda r: r.gossip_published > 0
    and r.prefix_hits > 0,
    "spike_pooled": lambda r: len(_acts(r)) > 0,
}


def _shorten(spec, duration):
    if spec.trace is not None:
        spec = dataclasses.replace(spec, trace=dataclasses.replace(
            spec.trace, duration_s=duration))
    return dataclasses.replace(spec, duration_s=duration)


def test_all_saved_specs_are_covered():
    assert sorted(Path(p).stem for p in SPECS) == sorted(FIRED)


@pytest.mark.parametrize("path", SPECS, ids=lambda p: Path(p).stem)
def test_saved_spec_matches_reference(path):
    ref = JE.ExperimentSpec.load(path)
    port = TE.ExperimentSpec.load(path)
    assert port.to_json() == ref.to_json()
    assert port.validate() is port
    assert TE.ExperimentSpec.from_json(port.to_json()) == port
    res_ref = _shorten(ref, SHORT_S).run()
    res_port = _shorten(port, SHORT_S).run(spec=_tpu_instance())
    assert FIRED[Path(path).stem](res_ref)
    assert _state(res_port) == _state(res_ref)


# ------------------------------------------------------------ the schema --
def _spec(side, mode="pooled", policy="least_loaded", scenario="spike",
          **cluster_kw):
    """`tests/test_api.py::_spec` on either side."""
    E, C, P, R, S = side
    kw = dict(prefill_mode=mode, prefill=None)
    if mode == "pooled":
        kw["prefill"] = P()
    kw.update(cluster_kw)
    return E.ExperimentSpec(
        name=f"test_{mode}_{policy}", scenario=scenario, duration_s=12.0,
        mean_rps=8.0, seed=1, sim=S(mode="harli", seed=2),
        cluster=C(n_initial=2, router=R(policy=policy), **kw))


REF_SIDE = (JE, JClusterConfig, JPoolConfig, JRouterConfig, JSimConfig)
PORT_SIDE = (TE, TClusterConfig, TPoolConfig, TRouterConfig, TSimConfig)

# the contradictions of test_api.py, as functions of (side, chunked,
# trace config)
CONTRADICTIONS = {
    "pooled without a pool": lambda s, ch, tc: _spec(s, "pooled",
                                                     prefill=None),
    "a pool outside pooled": lambda s, ch, tc: _spec(
        s, "chained", prefill=s[2](n_workers=4)),
    "chunked knobs in pooled": lambda s, ch, tc: _spec(
        s, "pooled", chunked=ch(budget_tokens=512)),
    "unknown routing policy": lambda s, ch, tc: _spec(
        s, "pooled", policy="least_loadedd"),
    "unknown scenario": lambda s, ch, tc: _spec(s, "pooled",
                                                scenario="spikey"),
    "non-overridable field": lambda s, ch, tc: _spec(
        s, "chained", instance_overrides=({"seed": 3},)),
    "trace disagrees": lambda s, ch, tc: dataclasses.replace(
        _spec(s, "chained"), duration_s=99.0,
        trace=tc(duration_s=12.0, mean_rps=8.0)),
}


def _spec_error(fn):
    with pytest.raises(Exception) as e:
        fn()
    return type(e.value).__name__, str(e.value)


@pytest.mark.parametrize("name", list(CONTRADICTIONS))
def test_spec_error_texts_match_reference(name):
    make = CONTRADICTIONS[name]
    ref = _spec_error(lambda: make(REF_SIDE, JChunked,
                                   JTraceConfig).validate())
    port = _spec_error(lambda: make(PORT_SIDE, TChunked,
                                    TTraceConfig).validate())
    assert ref[0] == "SpecError" and port == ref


DOCUMENTS = {
    "unknown top-level field": '{"nam": "typo"}',
    "unknown nested field": '{"sim": {"qos": 0.04}}',
    "not JSON": '{"sim": ',
    "not an object": "[1, 2]",
    "v2 block in v1": '{"tenants": [{"name": "a", "weight": 1.0}]}',
    "unsupported version": '{"schema_version": 3}',
    "inert failures": '{"schema_version": 2, "cluster": {"failures": '
                      '{"rate_per_min": 0.0, "warning_s": 0.0, '
                      '"checkpoint_interval_s": 0.0}}}',
    "gossip without cache": '{"schema_version": 2, "cluster": {"gossip": '
                            '{"period_s": 2.0}}}',
}


@pytest.mark.parametrize("name", list(DOCUMENTS))
def test_document_errors_match_reference(name):
    text = DOCUMENTS[name]
    ref = _spec_error(lambda: JE.ExperimentSpec.from_json(text).validate())
    port = _spec_error(lambda: TE.ExperimentSpec.from_json(text).validate())
    assert ref[0] == "SpecError" and port == ref


def test_v1_document_upgrades_as_the_reference():
    text = '{"name": "old", "scenario": "steady", "duration_s": 20.0}'
    port = TE.ExperimentSpec.from_json(text)
    assert port.schema_version == TE.SCHEMA_VERSION == JE.SCHEMA_VERSION
    assert port.to_json() == JE.ExperimentSpec.from_json(text).to_json()
    for mode in ("chained", "pooled", "chunked"):
        assert _spec(PORT_SIDE, mode).to_json() == \
            _spec(REF_SIDE, mode).to_json()


# ------------------------------------------------------------ launcher --
def _reference_main():
    spec = importlib.util.spec_from_file_location(
        "reference_cluster_sim", ROOT / "examples" / "cluster_sim.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main


@pytest.fixture(scope="module")
def reference_main():
    return _reference_main()


def _call(main, argv, monkeypatch, pass_argv):
    """(exit code, stdout, stderr) of `main` with `argv`, argparse's
    program name fixed; `_call.returned` holds what `main` returned."""
    monkeypatch.setattr(sys, "argv", ["cluster_sim.py", *argv])
    out, err = io.StringIO(), io.StringIO()
    code, _call.returned = 0, None
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            _call.returned = main(argv) if pass_argv else main()
        except SystemExit as e:
            code = e.code
    return code, out.getvalue(), err.getvalue()


DUMPS = {
    "defaults": [],
    "cache_aware": ["--policy", "cache_aware", "--scenario",
                    "session_heavy", "--rps", "14"],
    "chunked": ["--prefill-mode", "chunked", "--chunk-budget", "512",
                "--fuse-quantum", "--duration", "40"],
    "churn": ["--churn-rate", "2", "--churn-warning", "5",
              "--churn-checkpoint-interval", "15", "--migration-bw", "8",
              "--ladder", "--instances", "3"],
    "adapters": ["--tenants", "4", "--adapters", "--adapter-policy",
                 "replicate_hot"],
    "gossip": ["--policy", "cache_aware_gossip", "--scenario",
               "shared_prefix", "--gossip-period", "2"],
    "chained": ["--prefill-workers", "0", "--no-autoscale", "--seed", "3"],
}


@pytest.mark.parametrize("name", list(DUMPS))
def test_dump_spec_matches_reference(name, reference_main, tmp_path,
                                     monkeypatch):
    files = {}
    for who, main, pass_argv in (("ref", reference_main, False),
                                 ("port", TLAUNCH.main, True)):
        files[who] = tmp_path / f"{who}.json"
        code, out, _ = _call(main, DUMPS[name] + ["--dump-spec",
                                                  str(files[who])],
                             monkeypatch, pass_argv)
        assert code == 0 and out.startswith("spec written to")
    assert files["port"].read_bytes() == files["ref"].read_bytes()


REJECTED = {
    "workers in chained": ["--prefill-workers", "2", "--prefill-mode",
                           "chained"],
    "budget in pooled": ["--chunk-budget", "256"],
    "fuse in pooled": ["--fuse-quantum", "--prefill-mode", "pooled"],
    "flag beside --spec": ["--spec", "examples/specs/spike_pooled.json",
                           "--policy", "session_affinity"],
    "migration without warning": ["--churn-rate", "2", "--migration-bw",
                                  "8"],
    "adapters without tenants": ["--adapters"],
}


@pytest.mark.parametrize("name", list(REJECTED))
def test_cli_rejections_match_reference(name, reference_main, monkeypatch):
    argv = REJECTED[name]
    monkeypatch.chdir(ROOT)
    ref = _call(reference_main, argv, monkeypatch, False)
    port = _call(TLAUNCH.main, argv, monkeypatch, True)
    assert ref[0] == 2 and port == ref


def test_spec_runs_on_h100_instances(monkeypatch):
    monkeypatch.chdir(ROOT)
    path = os.path.join("examples", "specs", "spike_pooled.json")
    code, out, err = _call(TLAUNCH.main, ["--spec", path], monkeypatch, True)
    assert code == 0, err
    spec = JE.ExperimentSpec.load(path)
    lines = out.splitlines()
    n_req = len(spec.requests())
    assert lines[0].startswith(
        f"spec=spike_pooled  scenario=spike: {n_req} requests over 30s")
    assert lines[1] == "SLOs: TTFT<=4.0s TPOT<=40ms"
    assert lines[-1].startswith("harli/separate finetune throughput: ")
    for mode in ("separate", "harli"):
        assert sum(line.startswith(mode + " ") for line in lines) == 1
    # the instances are the port's default, H100s at the spec's tp
    harli = TE.ExperimentSpec.load(path).with_mode("harli").run()
    assert _state(_call.returned["harli"]) == _state(harli)
