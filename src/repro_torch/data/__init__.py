from .pipeline import SyntheticTextDataset
