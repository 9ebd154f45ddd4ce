"""Architecture configs, copied field for field from the JAX package's. One
module per arch; ``repro_torch.models.registry.load_config`` resolves ids
to CONFIG objects."""
