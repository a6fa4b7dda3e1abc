"""The LM stack's step builders."""
