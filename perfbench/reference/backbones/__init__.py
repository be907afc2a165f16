"""The reference's backbones, one file a name (see models.py)."""
