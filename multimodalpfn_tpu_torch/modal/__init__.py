"""Modality encoders (layer 0): DINOv2 for images, ELECTRA for text."""
