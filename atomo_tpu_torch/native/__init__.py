"""Host-side native code of the port: the lossless checkpoint codec."""
