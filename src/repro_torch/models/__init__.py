"""The decoder-only LM and its layers."""
