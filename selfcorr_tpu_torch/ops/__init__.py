"""Geometry, mesh builders, image ops, Umeyama/RANSAC, fused rasterizer."""
