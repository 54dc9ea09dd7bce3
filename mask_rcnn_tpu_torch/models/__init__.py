"""Models: ResNet-C4 backbone, RPN, RoI head, predict step, API."""
