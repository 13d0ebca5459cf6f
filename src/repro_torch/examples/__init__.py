"""Runnable examples of the port (``python -m repro_torch.examples.<name>``),
counterparts of the reference's ``examples/`` scripts. Each runs on the
CUDA card unless ``--device cpu`` is given."""
