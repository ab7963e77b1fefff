"""Host-side data: cv2-free crops, synthetic videos, the test loader."""
