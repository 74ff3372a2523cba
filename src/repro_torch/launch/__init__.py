"""Entry points: ``python -m repro_torch.launch.mine`` and ``python -m repro_torch.launch.serve --mine``."""
