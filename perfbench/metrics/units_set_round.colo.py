"""units_set_round.colo: % of the window's co-located rounds on the SM
split (k > 0) whose unit side ended after the decode side, by the
program's device marks (CUDA events at the fork, after decode on its
partition's stream, after the last unit on the units'): the rounds whose
length the units, not decode, set."""

from perfbench.harness.program_spans import program, units_set_round


def read(rec):
    spans = program()
    if spans is None or rec.trace is None:
        return None
    return units_set_round([m.read()[:2] for m in spans.marks()])
