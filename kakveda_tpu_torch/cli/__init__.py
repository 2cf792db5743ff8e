"""The port's command line (``python -m kakveda_tpu_torch.cli``)."""
