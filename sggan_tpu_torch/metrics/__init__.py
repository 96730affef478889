"""Segmentation scores (``scores``) and the dense CRF (``crf``)."""
