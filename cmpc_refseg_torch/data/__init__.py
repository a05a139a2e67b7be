"""Host-side data helpers of the port (text and image preprocessing)."""
