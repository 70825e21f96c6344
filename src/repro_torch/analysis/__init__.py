"""repro_torch.analysis — per-rank op counts, the roofline built from them,
and the dry-run tables (the torch port of ``repro.analysis``)."""
