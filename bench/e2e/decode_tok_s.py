"""``decode_tok_s``: every token the engine delivered in the window, each
request's first token included, over the window's seconds (host clock)."""


def compute(rec: dict, cell) -> float:
    return rec["tokens"] / rec["window_s"]
