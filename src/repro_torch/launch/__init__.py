"""Entry points: LM serving (``python -m repro_torch.launch.serve``) and
training (``python -m repro_torch.launch.train``)."""
