"""``decode_iter_ms`` (engine): the mean host time of the window's
``engine.step()`` iterations that ran no prefill chunk, in ms (host clock
around the call)."""


def read(rec: dict, cell) -> float | None:
    steps = rec.get("decode_only_step_s")
    return 1e3 * sum(steps) / len(steps) if steps else None
