"""Prediction: gridded and point requests, joint and AR sampling."""
