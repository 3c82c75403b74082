"""repro_torch.data — host-side input generators (numpy only)."""
