"""The data pipeline: indexed datasets, curriculum, data analysis and data routing."""
