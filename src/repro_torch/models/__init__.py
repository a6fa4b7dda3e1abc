"""The LM stack's models: config, parameters, layers and assembly."""
