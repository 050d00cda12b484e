"""The port's render chain."""
