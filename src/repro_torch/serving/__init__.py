"""The combining serving engine, copied from the reference package."""
