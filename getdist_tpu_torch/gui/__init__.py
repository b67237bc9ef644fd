"""GUI layer: the session logic, the streamlit web app, the Qt window and
shared plot-script generation."""
