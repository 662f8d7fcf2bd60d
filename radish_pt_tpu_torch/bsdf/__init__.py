"""BSDFs."""
