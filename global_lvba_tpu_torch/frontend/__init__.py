"""The SIFT frontend: extraction and all-pairs matching."""
