"""Entry points: LM serving (``python -m repro_torch.launch.serve``)."""
