"""The reference's plain ops."""
