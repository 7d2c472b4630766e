"""The shared harness: nothing here is specific to a configuration."""
