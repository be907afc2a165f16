"""The reference's branches, one file a name (see models.py)."""
