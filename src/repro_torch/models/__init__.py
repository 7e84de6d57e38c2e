"""Dense GQA transformer in PyTorch, mirroring ``repro.models``."""
