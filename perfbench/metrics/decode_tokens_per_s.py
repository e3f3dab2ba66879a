"""decode_tokens_per_s: output tokens emitted in the window (decode
rounds and the first token of each admission) over its seconds."""


def read(rec):
    return rec.tokens_out / rec.window_s
