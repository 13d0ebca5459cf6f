"""``setup_s``: process start to the first measured operation: imports,
CUDA, the kernel library's load (its build, in a checkout's first run),
the weights made on the device, ``compile_pim_params`` and the warm-up of
the cell's shapes (host clock)."""


def compute(rec: dict, cell) -> float:
    return rec["setup_s"]
