"""Launchers: the GraphGuard pre-launch verification CLI
(``python -m repro_torch.launch.verify``), the training launcher
(``python -m repro_torch.launch.train``) and the proof-provenance gate
(``python -m repro_torch.launch.explain_smoke``)."""
