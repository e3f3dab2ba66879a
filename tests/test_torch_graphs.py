"""The CUDA graph helper of the port (`core/graphs.py`) on the CPU: which
rounds replay graphs, how a replay counts the kernel launches it captured,
and the snapshot that undoes a capture's warm-up. Capturing needs the
card: `tests/test_torch_gpu.py` holds graphed rounds against eager ones
there."""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import graphs as G  # noqa: E402
from repro_torch.kernels import decode_attention as K1  # noqa: E402
from repro_torch.kernels import lora_matmul as K2  # noqa: E402
from repro_torch.kernels import ssd_scan as K3  # noqa: E402


@pytest.mark.parametrize("graphs,device,expect", [
    (None, "cpu", False), (False, "cpu", False), (None, "cuda", True),
    (None, "cuda:0", True), (False, "cuda", False), (True, "cuda", True)])
def test_graphs_by_default_on_the_card_only(graphs, device, expect):
    assert G.resolve(graphs, device) is expect


def test_graphs_asked_for_on_the_cpu_raise():
    with pytest.raises(ValueError, match="CUDA graphs need a CUDA device"):
        G.resolve(True, "cpu")


def test_every_kernel_counter_is_replayed():
    """Each wrapper lists all its counters, so a replay can move them."""
    for mod in (K1, K2, K3):
        names = {n for n in vars(mod)
                 if n.startswith("LAUNCHES") or n == "PLAIN_CALLS"}
        assert set(mod.COUNTERS) == names


class _Stub:
    replays = 0

    def replay(self):
        self.replays += 1


def test_a_replay_adds_its_captured_launches():
    stub = _Stub()
    graph = G.Graph(stub, {(K1, "LAUNCHES"): 32, (K2, "LAUNCHES"): 7,
                           (K2, "LAUNCHES_WGMMA"): 7})
    before = G._counts()
    graph.replay()
    graph.replay()
    after = G._counts()
    assert stub.replays == 2
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]
            } == {(K1, "LAUNCHES"): 64, (K2, "LAUNCHES"): 14,
                  (K2, "LAUNCHES_WGMMA"): 14}


def test_snapshot_undoes_a_warm_up_in_place():
    tree = {"a": torch.arange(4.0), "b": [torch.zeros(2), 3], "c": {}}
    saved = G.snapshot(tree)
    addresses = G.addresses(tree)
    tree["a"].add_(1.0)
    tree["b"][0].fill_(5.0)
    G.restore(saved)
    assert torch.equal(tree["a"], torch.arange(4.0))
    assert not tree["b"][0].any() and tree["b"][1] == 3
    assert G.addresses(tree) == addresses
