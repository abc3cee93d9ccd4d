"""JPL quaternions, SO(3) helpers and the chi-square table."""
