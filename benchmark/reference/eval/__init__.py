"""The reference's pose fit."""
