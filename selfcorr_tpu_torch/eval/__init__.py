"""Evaluation: pose fitting, exact 3D IoU, NOCS metrics, Tester."""
