"""utils subpackage."""
