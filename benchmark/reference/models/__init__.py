"""The reference's networks."""
