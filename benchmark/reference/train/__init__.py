"""The reference's training step."""
