"""Port of the matching crct_tpu subpackage."""
