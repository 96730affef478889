"""Segmentation scores (``scores``)."""
