"""repro_torch.core — the IPS4o engine: sampling, partition, level passes."""
