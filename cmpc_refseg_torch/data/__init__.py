"""Host-side data code of the port: text and image preprocessing, the
readers and the offline batch builders (numpy; nothing here imports
torch)."""
