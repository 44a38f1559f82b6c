"""Host-side helpers shared by the port's ops and engine layers."""
