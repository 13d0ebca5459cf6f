"""``compile_s`` (compile): wall seconds of ``compile_pim_params`` in
set-up, ending in a synchronize (host clock)."""


def read(rec: dict, cell) -> float:
    return rec["compile_s"]
