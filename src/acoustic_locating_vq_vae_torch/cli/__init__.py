"""Command-line entry points, run as ``python -m acoustic_locating_vq_vae_torch.cli.<name>``."""
