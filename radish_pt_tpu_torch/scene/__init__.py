"""Scene parsing, building and the on-device scene."""
