"""``input_tok_s``: input positions an encoder forwarded over the window's
seconds (host clock)."""


def compute(rec: dict, cell) -> float:
    return rec["input_positions"] / rec["window_s"]
