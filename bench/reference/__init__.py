"""Plain float32 references of the served models, one file a model
family, found by the `reference` key of a configuration file."""
