"""The comparison that decides `correct`, against the timed path broken
underneath (at smoke width, on the CPU), and the control."""

import pytest
import torch

from perfbench.tests import smoke


def _unchanged(monkeypatch):
    """A step that returns its state unchanged: AdamW does nothing."""
    from repro_torch.training import peft as P
    monkeypatch.setattr(P, "adamw_update_", lambda *a, **k: None)


def _half_batch(monkeypatch):
    """Half of the batch left out, the mean taken over the rest."""
    from repro_torch.training import peft as P
    orig = P.UnitEngine._head_loss

    def head_loss(self, x):
        saved = self.batch
        self.batch = {k: v[:1] for k, v in saved.items()}
        try:
            return orig(self, x[:1])
        finally:
            self.batch = saved
    monkeypatch.setattr(P.UnitEngine, "_head_loss", head_loss)


def _token_altered(monkeypatch):
    """Tokens altered where they are produced: the head's logits shifted
    by one id, so the served token is the next id after the best."""
    from repro_torch.models import model as MD
    orig = MD._head
    monkeypatch.setattr(MD, "_head", lambda *a: torch.roll(orig(*a), 1, -1))


FAULTS = {"state_unchanged": (_unchanged, ("grad_gap", "change_gap")),
          "half_batch": (_half_batch, ("loss_rel", "grad_gap")),
          "token_altered": (_token_altered, ("decode_gap",))}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_not_correct(smoke_root, fault, capsys, monkeypatch):
    plant, caught_by = FAULTS[fault]
    plant(monkeypatch)
    line, _ = smoke.run(smoke_root, "dense-smoke.colo", capsys=capsys,
                        monkeypatch=monkeypatch)
    assert line["correct"] is False
    failed = {k for k, x in line["checks"].items()
              if x["value"] > x["limit"]}
    assert failed & set(caught_by), line["checks"]


@pytest.mark.parametrize("workload", ["dense-smoke.colo", "moe-smoke.colo",
                                      "dense-smoke.long"])
def test_control_fails_a_number(smoke_root, workload, capsys, monkeypatch):
    """The control (the reference in float8 in the program's place) is
    judged as the program is and comes out not correct, where the sound
    program's numbers, printed beside it, are within every limit."""
    import json
    line, out = smoke.run(smoke_root, workload, control=True, capsys=capsys,
                          monkeypatch=monkeypatch)
    readings = json.loads(next(s for s in out.splitlines()
                               if s.startswith("readings "))[9:])
    assert line["correct"] is False
    checks = line["checks"]
    assert any(x["value"] > x["limit"] for x in checks.values()), checks
    assert all(readings[f"program_{k}"] <= x["limit"]
               for k, x in checks.items()), readings
    program_gap = readings["program_decode_gap"] if "decode_gap" in checks \
        else 0.0
    assert readings["control_decode_gap"] > 3 * max(program_gap, 1e-3)
