"""The input pipeline: host decode and the resident split (``loader``),
augmentation with explicit draws (``augment``) and the preprocess on the
device (``preprocess``)."""
