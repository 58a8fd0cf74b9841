"""Multi-GPU training of the port: the rank grid and collectives (`mesh`),
halo exchange (`spatial`), the D-sharded ModeT graph (`modet_sp`) and its
loss and step (`losses_sp`). Counterparts of `smilecode_tpu/parallel/`."""
