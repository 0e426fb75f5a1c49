"""Host utilities of the training CLIs: logging and TOML presets."""
