"""Launchers: the GraphGuard pre-launch verification CLI
(``python -m repro_torch.launch.verify``)."""
