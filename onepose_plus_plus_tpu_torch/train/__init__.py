"""Training of the 2D-3D matcher on one device: losses (``losses``), AdamW
with the MultiStep schedule and gradient accumulation (``train_step``), and
the epoch loop (``cli``, run as ``python -m onepose_plus_plus_tpu_torch.train``)."""
