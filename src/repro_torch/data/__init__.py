from repro_torch.data.synthetic import SyntheticLMDataset, SyntheticSeq2SeqDataset

__all__ = ["SyntheticLMDataset", "SyntheticSeq2SeqDataset"]
