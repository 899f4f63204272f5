"""The port's optimizer (`adamw`) and learning-rate schedules
(`schedules`)."""
