"""Layer tree, prefabs, codec and the high-level OCR API."""
