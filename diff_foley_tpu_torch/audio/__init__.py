"""The normalised-mel <-> wav transform chain."""
