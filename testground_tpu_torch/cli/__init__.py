"""The port's ``tg`` CLI (``python -m testground_tpu_torch.cli``)."""
