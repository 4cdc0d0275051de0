"""Entry points: LM serving (``python -m repro_torch.launch.serve``),
training (``python -m repro_torch.launch.train``) and the dry run
(``python -m repro_torch.launch.dryrun``)."""
