"""One adapter a kind of traffic: how a mix drives the system."""
