"""patch2pix_tpu_torch.utils."""
