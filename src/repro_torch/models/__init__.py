"""Transformers in PyTorch (GQA or MLA attention, dense or MoE FFNs),
mirroring ``repro.models``."""
