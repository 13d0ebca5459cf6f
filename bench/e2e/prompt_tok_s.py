"""``prompt_tok_s``: prompt tokens prefilled by the served model over the
window's seconds (host clock)."""


def compute(rec: dict, cell) -> float:
    return rec["input_positions"] / rec["window_s"]
