"""Training substrate of the port: AdamW (``optimizer``), the micro-batched
train step and loop (``train_loop``), atomic checkpoints (``checkpoint``)
and restart and straggler detection (``fault_tolerance``), on the
parameter trees of ``repro_torch.models.transformer``. Submodules are
imported by name."""
