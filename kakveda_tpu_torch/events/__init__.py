"""Host-side event plane."""
