"""Dense architecture configs ported so far. One module per arch;
``repro_torch.models.registry.load_config`` resolves ids to CONFIG objects."""
