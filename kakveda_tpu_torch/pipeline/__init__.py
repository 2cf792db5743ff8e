"""The intelligence pipeline: classification, patterns, warnings, health."""
