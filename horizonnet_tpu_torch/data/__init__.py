"""Training data: labels, augmentation, dataset, synthetic rooms."""
