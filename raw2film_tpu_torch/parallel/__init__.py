"""parallel subpackage."""
