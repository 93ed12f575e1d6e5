"""SZ-style error-bounded quantization and the compressor around it."""
