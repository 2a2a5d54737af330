"""Model configurations of the transformer zoo (copies of the reference's
published numbers; :func:`repro_torch.configs.base.get_config`)."""
