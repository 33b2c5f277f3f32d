"""The ControlNet tri-plane UNet."""
