"""Serving / evaluation encoders of the PyTorch port."""
