"""The voc drivers: ``train`` and ``evaluate``."""
