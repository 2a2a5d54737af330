"""Data for the transformer trainer (:mod:`repro_torch.data.pipeline`)."""
