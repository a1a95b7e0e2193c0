"""Tensor ops of the port: padding, resize, LSTM, wire decode, filters."""
