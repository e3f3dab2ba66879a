import json

from perfbench.harness import spec
from perfbench.tests.conftest import REPO


def test_benchmark_names_resolve_to_files():
    bench = spec.load(REPO)
    for c in bench["configs"]:
        assert (REPO / c["file"]).is_file()
        assert c["file"] == f"perfbench/configs/{c['name']}.json"
    for w in bench["workloads"]:
        spec.entry(bench, "configs", w["config"])
        spec.data(REPO, "configs", w["config"])
        spec.data(REPO, "traffic", w["traffic"])
        cell = spec.data(REPO, "cells", w["name"])
        assert cell["limits"]
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.reader(REPO, m["name"]))


def test_every_cell_reports_what_the_contract_asks():
    bench = spec.load(REPO)
    names = {w["name"] for w in bench["workloads"]}
    for w in names:
        e2e = [m["name"] for m in spec.metrics_for(bench, w, False)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert spec.metrics_for(bench, w, True)
    for m in bench["per_layer"]:
        assert set(m["workloads"]) <= names
        moved = spec.entry(bench, "end_to_end", m["moves"])
        for w in m["workloads"]:
            assert w in moved.get("workloads", [w])


def test_config_files_hold_the_published_sizes():
    for name, layers in (("qwen2.5-7b", 28), ("mixtral-8x7b-16l", 16)):
        cj = spec.data(REPO, "configs", name)
        arch = spec.arch_of(cj)
        assert arch.n_layers == layers and arch.head_dim == 128
        cfg = spec.model_config(cj)
        assert (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                cfg.vocab_size) == (arch.d, arch.n_heads, arch.n_kv,
                                    arch.vocab)
        assert cfg.norm_eps == float(cj["rms_norm_eps"])
    mix = spec.arch_of(spec.data(REPO, "configs", "mixtral-8x7b-16l"))
    assert (mix.n_experts, mix.top_k, mix.moe_ff) == (8, 2, 14336)


def test_a_new_cell_is_new_files_only(smoke_root):
    """A cell, a mix and a metric added as files, BENCHMARK.json gaining
    entries: the harness finds them by name, no other file edited."""
    mix = json.loads((smoke_root / "perfbench/traffic/chat-smoke.json")
                     .read_text())
    mix.update(name="chat-smoke-slow", warmup_s=0.25)
    (smoke_root / "perfbench/traffic/chat-smoke-slow.json").write_text(
        json.dumps(mix))
    (smoke_root / "perfbench/cells/dense-smoke.slow.json").write_text(
        json.dumps({"colocate": False, "rate_rps": 2.0,
                    "limits": {"decode_gap": 1.0}}))
    (smoke_root / "perfbench/metrics/rounds_per_s.py").write_text(
        "def read(rec):\n    return len(rec.rounds) / rec.window_s\n")
    bench = spec.load(smoke_root)
    bench["workloads"].append({"name": "dense-smoke.slow",
                               "config": "dense-smoke",
                               "traffic": "chat-smoke-slow", "chips": 1,
                               "why": "a cell added as data"})
    bench["per_layer"].append({"name": "rounds_per_s", "unit": "1/s",
                               "better": "higher", "source": "host_clock",
                               "layer": "serving engine",
                               "moves": "decode_tokens_per_s",
                               "workloads": ["dense-smoke.slow"]})
    (smoke_root / "BENCHMARK.json").write_text(json.dumps(bench))
    bench = spec.load(smoke_root)
    assert spec.data(smoke_root, "traffic", "chat-smoke-slow")["warmup_s"] \
        == 0.25
    assert [m["name"] for m in spec.metrics_for(bench, "dense-smoke.slow",
                                                True)] == ["rounds_per_s"]
    read = spec.reader(smoke_root, "rounds_per_s")

    class Rec:
        rounds, window_s = [1, 2, 3], 1.5
    assert read(Rec()) == 2.0
