"""Training data: TartanAir, the synthetic box scenes, augmentation and frame graphs."""
