"""Optimizers (SGD, AdamW) with UNIQ freeze masks."""
