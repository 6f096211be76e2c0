"""Depth Pro in PyTorch: ViT, pyramid encoder, DPT decoder, depth head, FOV head."""
