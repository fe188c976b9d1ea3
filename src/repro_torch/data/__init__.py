"""Named road-graph presets."""
