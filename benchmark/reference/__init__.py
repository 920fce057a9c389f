"""The plain reference: AES-256-GCM, RSA-OAEP and the stored format, read
with PyTorch, NumPy and the standard library alone."""
