"""The plain reference and the operation counts, one file per model family."""
