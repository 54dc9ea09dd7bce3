"""The coco drivers: ``train`` and ``evaluate``."""
